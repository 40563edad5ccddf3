"""The jobs a traffic mix drives the program with, one module a job (``eval``,
``train``), found by the mix's ``job``."""
