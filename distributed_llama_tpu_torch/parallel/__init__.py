"""Tensor parallelism over torch.distributed: the port's counterpart of the JAX
package's parallel/ (mesh, sharding, tp, collectives; traffic replaces hlo_stats) plus
launch.py, which starts local ranks.

The modules are imported by name (parallel.mesh, parallel.tp, ...): models/forward.py
imports parallel.collectives, and parallel.tp imports models/forward.py.
"""
