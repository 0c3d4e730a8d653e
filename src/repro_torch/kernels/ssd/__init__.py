"""K9: the Mamba-2 SSD chunk scan."""
