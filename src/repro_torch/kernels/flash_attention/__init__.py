"""K8: causal or bidirectional GQA flash attention (forward)."""
