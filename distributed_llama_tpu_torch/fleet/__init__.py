"""The replica's side of a fleet: `disagg.py`, the prefill/decode disaggregation's
transfer table and KV import (a copy of the replica-side half of the JAX package's
fleet/disagg.py). The router side needs no port: the JAX package's stdlib router fronts
the port's servers as they are."""
