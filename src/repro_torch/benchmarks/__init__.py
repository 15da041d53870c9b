"""The port's benchmark drivers: the paper's Figures 1-3 (ports of
`benchmarks/fig1_quadratic.py`, `fig2_robust_regression.py` and
`fig3_fixed_point.py`), each run as
`python -m repro_torch.benchmarks.<name> [--device cpu]` and printing the
reference's CSV table.  They run on the JAX package's data (the committed
fixtures), so their tables compare with the reference's row by row."""
