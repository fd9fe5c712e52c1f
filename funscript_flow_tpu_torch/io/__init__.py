"""Host decode and funscript JSON."""
