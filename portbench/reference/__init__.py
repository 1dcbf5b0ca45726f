"""Plain PyTorch references of the benchmark's entries.

``frozen/`` is a frozen copy of the plain PyTorch functions of the port
that the two entries reach at the benchmark's configurations (one SLIC
path, one enforcement path, the colour, LM texture and gray features, the
forest and GMM predictions, the 'model'-edge grid MRFs), with every
branch that dispatched to a hand kernel taken out, so each runs on any
device.  It imports nothing of the port; the port's later changes do not
reach it.  :mod:`sup2d` and :mod:`gray3d` chain it as the two entries do.
"""
