"""K2-K4 and K7: the FALKON K_nM contractions."""
