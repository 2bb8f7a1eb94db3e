"""The training launcher and the meshes (the port's copy of the JAX
package's ``launch/train.py`` and ``launch/mesh.py``)."""
