"""Model-based speculative drafting (the port's copy of the JAX package's draft/).

A second, small model beside the target on the same card drafts k tokens per row in one
scan dispatch (draft/loop.py, each step a CUDA graph replay on the card); the target's
batched verify (runtime/device_loop.py make_batched_verify_loop) then accepts or rejects
the drafts with the usual token-identity guarantee. Imported lazily (PEP 562), like the
cache package: importing the package costs nothing until a drafter is constructed.
"""

_EXPORTS = {
    "ModelDrafter": ".drafter",
    "make_draft_loop": ".loop",
    "make_draft_step": ".loop",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(name)


__all__ = list(_EXPORTS)
