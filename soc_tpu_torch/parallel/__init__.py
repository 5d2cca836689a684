"""Multi-device execution: the `devices N` product path (``product``) and
its sharded orthographic render (``mesh``)."""
