"""K5: the fused Eq. 3 RLS score."""
