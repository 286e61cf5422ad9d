"""The Collie measurement and search logic of the port: search space, bench
scale, analytic floors, counters and the anomaly monitor."""
