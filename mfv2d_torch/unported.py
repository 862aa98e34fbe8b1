"""The error raised for a feature of the JAX package that the port lacks."""


def not_ported(feature: str, item: str) -> NotImplementedError:
    """``NotImplementedError`` naming ``feature`` and the ROADMAP item that
    will port it."""
    return NotImplementedError(
        f"{feature} is not ported to mfv2d_torch yet (ROADMAP 'Modules still"
        f" to port', item {item})."
    )
