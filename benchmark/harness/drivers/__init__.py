"""One module a load driver, named by a mix's ``driver`` key; each defines
``Driver``."""
