"""Model families of the port: TAM/CTR-GCN, ST-GCN, the ResNet RGB branch
and the cross-modal fusion model."""
from .ctrgcn import CTRGC, CTRGCN, create_ctrgcn_nucla  # noqa: F401
from .resnet_gcn_attention import ResNetGCNAttention
from .resnet_only import ResNetOnly
from .stgcn import STGCN, create_stgcn_nucla, edge_importance_per_joint  # noqa: F401

_REGISTRY = {
    "ctrgcn": CTRGCN,
    # reference config compatibility (config/nucla/*.yaml model: keys)
    "models.ctrgcn.Model": CTRGCN,
    "stgcn": STGCN,
    "models.stgcn.Model": STGCN,
    "resnet_only": ResNetOnly,
    "models.resnet_only.Model": ResNetOnly,
    "resnet_gcn_attention": ResNetGCNAttention,
    "models.resnet_gcn_attention.ResNet_GCN_Attention": ResNetGCNAttention,
}


def get_model(name: str, **model_args):
    """Instantiate a registered model by name. A `generator` keyword seeds
    the parameters; `dtype` (the config's model_args.dtype) is the compute
    dtype, float32 (None) or bfloat16 with float32 parameters, and any other
    raises."""
    dtype = model_args.get("dtype")
    if dtype not in (None, "float32", "bfloat16"):
        raise NotImplementedError(
            f"model dtype {dtype!r}: the port computes in float32 or in "
            "bfloat16 (mixed precision, float32 parameters)"
        )
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return cls(**model_args)
