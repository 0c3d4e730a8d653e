"""One module per entry of the program that a traffic mix drives: its
outputs, the numbers that judge them, and the reference's own outputs."""
