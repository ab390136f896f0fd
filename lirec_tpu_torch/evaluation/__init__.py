"""Evaluation of the port: metric accumulators, device-side metric
reductions and the packed eval sweep."""
