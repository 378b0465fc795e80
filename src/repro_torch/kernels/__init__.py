"""Hand-written CUDA kernels for the fused query fragments, each beside
its plain torch version (``ops`` dispatches on the inputs' device)."""
