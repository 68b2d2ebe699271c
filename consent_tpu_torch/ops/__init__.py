"""Device compute: batched alignment DP, consensus voting, k-mer tables."""
