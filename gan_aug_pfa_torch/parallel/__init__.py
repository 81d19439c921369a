"""Training over several cards: the JAX package's mesh axes as one
process a card with ``torch.distributed`` groups (``mesh.py``): 'data'
with BatchNorm statistics over the global batch (``batchnorm.py``),
'model' with the wide leaves sharded (``tensor.py``), and 'spatial' with
the feature maps' height split and halo exchanges (``spatial.py``)."""
