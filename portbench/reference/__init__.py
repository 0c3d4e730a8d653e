"""The benchmark's plain reference (PyTorch only): ``krr`` computes, ``judge``
and each entry's ``entries/<entry>.py`` compare. Nothing here imports the
program."""
