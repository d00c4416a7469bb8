"""Host-side metric meters."""
