"""Data pipeline: NW-UCLA feeder (train and val splits), synthetic feeder,
batch loader."""
from .feeder_nucla_gcn import NUCLAFeederGCN  # noqa: F401
from .loader import Loader  # noqa: F401
from .splits import load_nucla_split  # noqa: F401
from .synthetic import SyntheticSkeletonFeeder  # noqa: F401

_REGISTRY = {
    "nucla_gcn": NUCLAFeederGCN,
    "feeder.feeder_nucla_gcn.Feeder": NUCLAFeederGCN,
    "synthetic_gcn": SyntheticSkeletonFeeder,
}
_LATER = {
    "skeleton_gcn": "the NTU slice",
    "nucla_resnet": "the RGB slice",
    "feeder.feeder_nucla_resnet.Feeder": "the RGB slice",
    "synthetic_rgb": "the RGB slice",
    "nucla_fusion": "the cross-modal slice",
    "feeder.feeder_nucla_fusion.Feeder": "the cross-modal slice",
    "synthetic_fusion": "the cross-modal slice",
}


def resolve_feeder(name: str):
    """Feeder class by registry name. The RGB, fusion and generic skeleton
    feeders of the JAX package come with later slices and raise."""
    if name in _LATER:
        raise NotImplementedError(f"feeder {name!r} comes with {_LATER[name]}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown feeder {name!r}; the port has {sorted(_REGISTRY)}"
        ) from None


def feeder_accepts_seed(name: str) -> bool:
    """True if the named feeder's constructor takes a `seed` parameter."""
    import inspect

    params = inspect.signature(resolve_feeder(name).__init__).parameters
    return "seed" in params


def get_feeder(name: str, **feeder_args):
    """Instantiate a registered feeder by name."""
    return resolve_feeder(name)(**feeder_args)
