"""Model stack of the port (the dense transformer family): shared blocks
in ``common``, the stack in ``transformer``, the uniform API in
``registry``."""
