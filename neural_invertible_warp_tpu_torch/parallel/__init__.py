"""Ray-axis data parallelism over several GPUs (``mesh``) and the invariance
audit that drives it in worker processes (``audit``)."""
