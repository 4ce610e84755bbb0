"""Device runtime of the port: engine selection, kernel build, GPU engine."""
