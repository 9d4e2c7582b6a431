"""The model stack (PyTorch): parameters, layers, the transformer
assembly and its facade."""
