from .checkpoint import load_pytree, load_tree, save_pytree, save_tree  # noqa: F401
