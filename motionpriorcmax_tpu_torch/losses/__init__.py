"""Self-supervised contrast-maximization loss (JAX: losses/)."""

from .focus import FocusLossConfig, focus_loss, get_reconstruction_times

_LOSSES = {"FOCUS": FocusLossConfig}


def make_loss(loss_name: str, **kwargs) -> FocusLossConfig:
    """Config of the named loss from YAML leaves; unknown leaves are
    dropped, as in the JAX factory."""
    try:
        cls = _LOSSES[loss_name]
    except KeyError:
        raise ValueError(f"unknown loss {loss_name!r}") from None
    fields = set(cls.__dataclass_fields__)
    return cls(**{k: v for k, v in kwargs.items() if k in fields})


__all__ = ["FocusLossConfig", "focus_loss", "get_reconstruction_times",
           "make_loss"]
