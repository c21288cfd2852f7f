"""Scale-out over torch.distributed ranks (``mesh.py``)."""
