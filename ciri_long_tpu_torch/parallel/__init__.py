"""Parallel layers of the port: collapse's dispatch fuser, the drain
between a host pool and the card, and the mesh scan (records, mesh,
cohort, multihost_worker, dryrun)."""
