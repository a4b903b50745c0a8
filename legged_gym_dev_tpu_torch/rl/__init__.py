from .networks import ActorCritic, ActorCriticRecurrent
from .ppo import (
    PPOConfig,
    RolloutBatch,
    TrainState,
    compute_gae,
    init_train_state,
    make_learn_iteration,
    ppo_update,
    rollout,
)

__all__ = ["ActorCritic", "ActorCriticRecurrent", "PPOConfig",
           "RolloutBatch", "TrainState", "compute_gae", "init_train_state",
           "make_learn_iteration", "ppo_update", "rollout"]
