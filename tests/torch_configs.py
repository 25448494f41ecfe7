"""The port's configuration trees as the JAX package's: the port has fields
that the JAX package does not (SDXL's); a port tree that holds them at their
defaults reads as the JAX tree without them."""

import dataclasses

PORT_ONLY = {"num_head_channels": -1, "use_linear_in_transformer": False,
             "adm_in_channels": None, "conditioner": None}


def _without_port_only(node: dict) -> dict:
    for key, default in PORT_ONLY.items():
        if key in node:
            assert node.pop(key) == default, key
    for value in node.values():
        if isinstance(value, dict):
            _without_port_only(value)
    return node


def jax_tree(cfg) -> dict:
    """``dataclasses.asdict`` of a port config without the port's own
    fields, each asserted at its default."""
    return _without_port_only(dataclasses.asdict(cfg))
