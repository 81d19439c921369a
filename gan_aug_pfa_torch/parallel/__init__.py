"""Data-parallel training over several cards: the JAX package's 'data'
mesh axis (``parallel/mesh.py``) as one process a card with a
``torch.distributed`` group (``mesh.py``), and BatchNorm with statistics
over the global batch (``batchnorm.py``)."""
