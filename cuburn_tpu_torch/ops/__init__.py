"""Device-side building blocks of the renderer, in PyTorch."""
