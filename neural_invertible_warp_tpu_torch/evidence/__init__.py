"""The quality harness: the JAX package's quality probes (tools/evidence_r2.py,
tools/probe_b3.py, tools/probe_zoo_r4.py, tools/probe_dtu.py,
tools/probe_extra_datasets.py) on the port, with their scenes made in memory
and their option files as dicts."""
