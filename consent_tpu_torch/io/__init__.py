"""Host data plane: sequence encoding, FASTA/FASTQ, PAF, pile streaming."""
