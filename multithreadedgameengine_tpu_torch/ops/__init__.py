"""Device ops of the port: binning, physics, the grid solver, kernels."""
