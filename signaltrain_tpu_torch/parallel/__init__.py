"""Data parallelism over processes: the process group, the mesh, the launcher."""
