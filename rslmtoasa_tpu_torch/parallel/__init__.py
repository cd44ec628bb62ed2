"""Distribution over ranks (``mesh``, ``launch``) and the engine dispatch
of the recursions (``dispatch``)."""
