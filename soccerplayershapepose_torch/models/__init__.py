"""Regressor networks: ResNet encoders and the IEF head."""

from soccerplayershapepose_torch.models.regressor import (  # noqa: F401
    SingleInputRegressor)
