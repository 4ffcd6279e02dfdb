# GraphPi workload configuration (patterns and named datasets).
