"""The plain float32 reference that decides `correct`: the network
(`model`), the training loss and Adam (`train`). Plain PyTorch only."""
