"""Code shared by the drivers: files by name, the card, traces, peaks."""
