"""K2-K4: the FALKON K_nM contractions."""
