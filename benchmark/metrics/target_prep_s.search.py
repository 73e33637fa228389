"""Seconds a completed search job spends rebuilding target-side state: the
program's load_targets, prefilter_init, driver_init and align.target_stage
spans, as target_prep_s.predict reads them."""

from benchmark.run import load_metric

read = load_metric("target_prep_s.predict").read
