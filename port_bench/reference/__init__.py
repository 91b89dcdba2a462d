"""The plain reference that decides ``correct``: the frontend in plain
PyTorch, on any device, importing nothing of the program.

A frozen copy of the port's plain versions, taken when the benchmark was
defined, so that a later change to the program is held to what the
frontend computed then: ``config.py`` (``SiftConfig``), ``kp_types.py``
(``core/types.py``), ``gaussian.py`` (the taps of ``ops/gaussian.py``;
the blur itself a banded matrix product, see there), ``extrema.py``, ``refine.py``, ``sampling.py``
(with the window-sampling kernel's plain version) and ``descriptor.py``
(``ops/``), and ``frontend.py``: the octave kernel's plain version and the
entry points' route (``models/frontend.py``). The copies differ from their
originals only in their imports, in that blur, and in leaving the TF32
guard to the caller (``frontend.py::precision``).
"""
