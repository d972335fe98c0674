"""The distributed sort-join engine: the mesh (mesh.py), one distributed
step (sortshard.py), the engine (distpipe.py) and its multi-process entry
(multihost.py)."""
