"""Tenant identity (a copy of the JAX package's tenancy plane, cut to
what the frontend mints)."""
