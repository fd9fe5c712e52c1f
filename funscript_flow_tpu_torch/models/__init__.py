"""The per-window flow program and its streaming driver."""
