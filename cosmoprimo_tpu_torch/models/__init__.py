"""Engine implementations (compute backends for Cosmology sections)."""
