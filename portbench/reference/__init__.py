"""Plain references in PyTorch and NumPy.  They import nothing of the
program, nor JAX: each works out from the benchmark's own inputs what the
program derives from them (the split, the batch order, the dropout masks,
the bins, the subsample masks) and computes the result anew."""
