"""Frozen copies of the port's plain host code, for the benchmark's reference.

Each module here is a copy of the module of the same path under
``rslmtoasa_tpu_torch/``, taken when the benchmark was defined, with the
file readers removed (the reference builds its inputs itself).  The program
may change its own modules; the yardstick stays as it is.  Nothing here
imports the program, JAX or the JAX package.

* ``atoms/potential.py``: ``Potential`` (``build_pot``, ``predls``,
  ``d_matrix``), ``Element``, ``SymbolicAtom``;
* ``geometry/strconst.py``, ``geometry/crystal.py``: the screened structure
  constants and the primitive cells;
* ``physics/``: the spherical harmonics, the energy mesh, ``Bands`` (Fermi
  level, moments), the linear ``Mixer``, the bulk Madelung sums, the Python
  atomic-sphere solver (``atomsphere.py``, ``radial.py``, ``xc_lda.py``) and
  the Simpson rules;
* ``ops/terminator.py``: the Pettifor terminator fits.
"""
