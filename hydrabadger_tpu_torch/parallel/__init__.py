"""Multi-device scale-out of the tensor planes over torch.distributed (mesh.py)."""
