from arco_torch.models.factory import net_factory, net_factory_3d  # noqa: F401
