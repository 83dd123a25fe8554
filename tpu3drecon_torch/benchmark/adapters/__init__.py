"""The benchmark harness's framework adapters: the port's own solvers
(``torch_adapters``), scipy, and the gated COLMAP and GTSAM baselines."""
