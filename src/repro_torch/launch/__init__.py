"""Process launch: rank processes and their process group (mesh.py)."""
