"""Data parallelism across processes: the process group and its
collectives (dist), and the ring-sharded point ops (ring_pointops)."""
