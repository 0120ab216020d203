"""Data parallelism: multi-process training over torch.distributed and a
mesh of local devices for serving and eval (`parallel/mesh.py`)."""
