"""Distributed runtime of the port (a copy of the JAX package's runtime/,
on the standard library): discovery, leases, push RPC, response
streaming.

  - a **control-plane store** with etcd semantics — keys, leases,
    prefix watch, lease-expiry-deletes-keys — served by store.py and
    reachable over one TCP socket; its frames are byte-equal to the JAX
    package's, so either package's clients and workers share one store;
  - **push RPC with streamed responses** — each endpoint instance listens
    on its own TCP port registered in the store; routers connect directly
    and read a framed response stream;
  - the **Namespace -> Component -> Endpoint** model with lease-bound
    instance registration (instance = ns+component+endpoint+lease_id).
"""
from dynamo_tpu_torch.runtime.client import KvClient, Lease
from dynamo_tpu_torch.runtime.component import (
    DistributedRuntime,
    Endpoint,
    EndpointClient,
    Instance,
)
from dynamo_tpu_torch.runtime.store import KvStore, serve_store

__all__ = [
    "KvClient", "Lease", "KvStore", "serve_store",
    "DistributedRuntime", "Endpoint", "EndpointClient", "Instance",
]
