"""Host ingest: Matrix Market reader and synthetic generators (numpy)."""
