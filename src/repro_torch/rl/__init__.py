"""RL loop of the port: GRPO, rollouts and the trainer. Submodules are
imported explicitly (``from repro_torch.rl.trainer import Trainer``)."""
