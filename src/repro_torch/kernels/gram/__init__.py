"""K1: the dense Gram kernel."""
