"""FLOPs of the SAC networks from their shapes: 2 per multiply-add of every
linear layer (elementwise work not counted).  A backward pass through a
layer costs twice its forward (the input's and the weights' gradients),
once where only the input's gradient is taken (the critic under the policy
loss)."""


def mlp_flops(sizes) -> float:
    return float(sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:])))


def policy_forward(obs_dim: int, act_dim: int, hidden: int) -> float:
    """Per row: two hidden layers, then the mean and the log-std heads."""
    return mlp_flops([obs_dim, hidden, hidden]) + 2 * 2 * hidden * act_dim


def critic_forward(obs_dim: int, act_dim: int, hidden: int) -> float:
    """Per row: the twin Q networks."""
    return 2 * mlp_flops([obs_dim + act_dim, hidden, hidden, 1])


def update(obs_dim: int, act_dim: int, hidden: int, batch: int) -> float:
    """One update: the target (policy and target critic forward), the
    critic step (forward and backward), the policy step (policy forward and
    backward, critic forward and its input's gradient)."""
    pf = policy_forward(obs_dim, act_dim, hidden)
    qf = critic_forward(obs_dim, act_dim, hidden)
    target = pf + qf
    critic = 3 * qf
    policy = 3 * pf + 2 * qf
    return batch * (target + critic + policy)
