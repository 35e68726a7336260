"""Host-side helpers that take numpy arrays (the PNG writer)."""
