"""Measurement entry points of the port: python -m monodepth2_torch.tools.<name>."""
