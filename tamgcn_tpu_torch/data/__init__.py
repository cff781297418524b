"""Data pipeline: the NW-UCLA skeleton, ST-ROI image and fusion feeders,
the generic skeleton feeder (NTU), the synthetic feeders, batch loader."""
from .feeder_nucla_fusion import NUCLAFeederFusion
from .feeder_nucla_gcn import NUCLAFeederGCN  # noqa: F401
from .feeder_nucla_resnet import NUCLAFeederResNet
from .feeder_skeleton_gcn import SkeletonFeederGCN
from .loader import Loader  # noqa: F401
from .splits import load_nucla_split  # noqa: F401
from .synthetic import (SyntheticFusionFeeder, SyntheticRGBFeeder,  # noqa: F401
                        SyntheticSkeletonFeeder)

# every name of the JAX package's registry (tamgcn_tpu/data/__init__.py)
_REGISTRY = {
    "nucla_gcn": NUCLAFeederGCN,
    "feeder.feeder_nucla_gcn.Feeder": NUCLAFeederGCN,
    "nucla_resnet": NUCLAFeederResNet,
    "feeder.feeder_nucla_resnet.Feeder": NUCLAFeederResNet,
    "nucla_fusion": NUCLAFeederFusion,
    "feeder.feeder_nucla_fusion.Feeder": NUCLAFeederFusion,
    "skeleton_gcn": SkeletonFeederGCN,
    "synthetic_gcn": SyntheticSkeletonFeeder,
    "synthetic_fusion": SyntheticFusionFeeder,
    "synthetic_rgb": SyntheticRGBFeeder,
}


def resolve_feeder(name: str):
    """Feeder class by registry name."""
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
