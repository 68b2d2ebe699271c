"""Window geometry and device batching."""
