"""The port's training step against the JAX make_train_step for HyperSeg-L
CamVid (HYPERSEG_L_KW) at 128x256, on both training routes:
tests/torch_train_parity.py's cases, runs and tests for model "L" (ids
"L-gather", "L-fullmap")."""

from torch_train_parity import (  # noqa: F401  (collected here)
    test_first_step_loss,
    test_first_step_gradients,
    test_first_step_adam_updates,
    test_first_step_adam_rule,
    test_first_step_bn_running_stats,
    test_backbone_momentum_is_0_01,
    test_step_confusion_matrices,
    test_loss_at_jax_parameters,
    test_three_step_loss_trajectory,
    runs_fixture,
)

runs = runs_fixture("L")
