"""The plain reference that decides ``correct``: float32 PyTorch, no
import of the port, the JAX package or JAX."""
