"""The Collie measurement and search logic of the port: search space, bench
scale, analytic floors, counters, the anomaly monitor, the engine with its
caches and surrogate, the search drivers (simulated annealing, random, BO),
MFS construction, the witness minimiser and the catalog."""
