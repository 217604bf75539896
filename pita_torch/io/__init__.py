from pita_torch.io.flax_params import (
    egnn_params_from_tree,
    load_egnn_params,
    msgpack_restore,
    trainer_state_from_tree,
)

__all__ = ["egnn_params_from_tree", "load_egnn_params", "msgpack_restore",
           "trainer_state_from_tree"]
