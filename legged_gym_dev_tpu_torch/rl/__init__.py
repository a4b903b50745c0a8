from .networks import ActorCritic
from .ppo import PPOConfig, RolloutBatch, compute_gae, rollout

__all__ = ["ActorCritic", "PPOConfig", "RolloutBatch", "compute_gae",
           "rollout"]
