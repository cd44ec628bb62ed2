"""Engine dispatch of the recursions (single device; see ``dispatch``)."""
