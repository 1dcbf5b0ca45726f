"""One module per entry of the program: ``Driver(config, device)``
with ``setup``, ``call`` (the timed public call), ``capture`` (the same call
that also hands back its intermediate results), ``judge`` (the numbers of
a capture's outputs against the reference) and ``control`` (the reference
in the configuration's control precision, in a capture's place).  A
configuration names its driver in ``driver``."""
