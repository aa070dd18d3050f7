"""The plain reference of the benchmark's configurations: plain PyTorch and
NumPy, written from the documented semantics of what the program serves and
trains. It imports nothing of the program, of ``tumseg`` or of JAX, and
works out again whatever the program derives (tables, grids, blocks,
draws)."""
