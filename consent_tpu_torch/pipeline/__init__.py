"""End-to-end correction / polishing pipelines."""
