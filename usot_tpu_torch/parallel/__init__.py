"""Data parallelism: the device mesh, the process group and the rank
launcher (`parallel/mesh.py`), and the step runs that hold a data-parallel
step against one process (`parallel/steps.py`)."""
