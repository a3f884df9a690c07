"""Request deadlines and priority classes (a copy of the JAX package's
overload plane, cut to the hints the frontend carries to the engine)."""
