"""Homoscedastic multi-task loss."""

from soccerplayershapepose_torch.losses.multi_task import (  # noqa: F401
    MultiTaskLossConfig, init_loss_state, multi_task_loss)
