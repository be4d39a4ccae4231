"""Reference trace generators, one file per workload name."""
