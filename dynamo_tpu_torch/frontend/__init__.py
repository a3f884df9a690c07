"""The OpenAI HTTP frontend of the port (a copy of the JAX package's
frontend/, on the standard library)."""
