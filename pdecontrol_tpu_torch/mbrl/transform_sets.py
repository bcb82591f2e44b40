"""The controller's transform wiring (port of
``pdecontrol_tpu/mbrl/transform_sets.py``; reference ``setup_transforms``,
mbrl.py:146-188).

Spaces:
  * raw/physical — env fields and env-bounds actions (what the replay stores).
  * world — surrogate space: obs = world_sensor(oscaling(raw)); actions =
    world_sensor(pdescaling(forcing(env_action))) (the forcing FIELD).
  * agent — SAC space: obs = agent_sensor(world_obs); actions in [-1, 1].

``oscaling`` is the only transform that updates during collection (running
min/max, reference ``TransformObsWrapper``, vec_wrappers.py:157-160).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pdecontrol_tpu_torch.envs.transforms import (
    Chain,
    GaussianForcing,
    Normalize,
    SampleTransform,
    Scale,
    Sensor,
    Transform,
)


@dataclasses.dataclass(frozen=True, eq=False)
class ControllerTransforms:
    oscaling: Scale
    ascaling: Transform  # inverse view: apply = [-1,1] -> env bounds
    forcing: GaussianForcing
    pdescaling: Scale
    undscaling: Normalize
    agent_sensor: Sensor
    world_sensor: Sensor

    @classmethod
    def create(cls, env, agent_stride: int = 1, world_stride: int = 1,
               dtype: torch.dtype = torch.float32, device=None) -> "ControllerTransforms":
        obs_shape = (1,) + tuple(env.obs_shape)  # [B, C, H]
        act_shape = (1,) + tuple(env.action_shape)

        oscaling = Scale.create(obs_shape, aggregate=True, batched=True,
                                frozen=False, dtype=dtype, device=device)

        low = np.full(act_shape, env.action_low, np.float32)
        high = np.full(act_shape, env.action_high, np.float32)
        ascaling = Scale.create(
            act_shape, bounds=(low, high), aggregate=True, batched=True,
            frozen=True, dtype=dtype, device=device,
        ).inv

        forcing = env.forcing

        def field(a):
            return forcing.apply(torch.as_tensor(a, dtype=dtype, device=device)).cpu().numpy()

        flow, fhigh = field(low), field(high)
        # Jet superposition can exceed single-jet extremes in either sign;
        # pool elementwise min/max like the reference's bounds intent.
        pdescaling = Scale.create(
            flow.shape[1:],
            bounds=(np.minimum(flow, fhigh)[0], np.maximum(flow, fhigh)[0]),
            aggregate=True, frozen=True, dtype=dtype, device=device,
        )

        undscaling = Normalize.create(obs_shape, aggregate=True, batched=True,
                                      dtype=dtype, device=device)

        return cls(
            oscaling=oscaling,
            ascaling=ascaling,
            forcing=forcing,
            pdescaling=pdescaling,
            undscaling=undscaling,
            agent_sensor=Sensor(stride=agent_stride),
            world_sensor=Sensor(stride=world_stride),
        )

    def replace(self, **changes) -> "ControllerTransforms":
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------ obs paths
    def raw_to_world_obs(self, raw):
        return self.world_sensor.apply(self.oscaling.apply(raw))

    def world_to_agent_obs(self, world_obs):
        return self.agent_sensor.apply(world_obs)

    def raw_to_agent_obs(self, raw):
        return self.world_to_agent_obs(self.raw_to_world_obs(raw))

    def world_to_raw_obs(self, world_obs):
        return self.oscaling.inverse(self.world_sensor.inverse(world_obs))

    # --------------------------------------------------------- action paths
    def agent_to_env_action(self, action):
        """[-1,1] -> env bounds (TransformActionWrapper(ascaling), mbrl.py:269)."""
        return self.ascaling.apply(action)

    def env_action_to_agent(self, action):
        return self.ascaling.inverse(action)

    def env_action_to_world(self, action):
        """env-bounds action -> scaled forcing field (the world env's action
        space; mbrl.py:321-330 stack: forcing -> pdescaling -> sensor)."""
        return self.world_sensor.apply(self.pdescaling.apply(self.forcing.apply(action)))

    def world_action_to_phys_field(self, waction):
        return self.pdescaling.inverse(self.world_sensor.inverse(waction))

    # ------------------------------------------------------- sample bridges
    @property
    def replay_to_agent(self) -> SampleTransform:
        return SampleTransform(
            otransf=Chain(transforms=(self.oscaling, self.agent_sensor)),
            atransf=self.ascaling.inv,
        )

    @property
    def replay_to_world(self) -> SampleTransform:
        return SampleTransform(
            otransf=Chain(transforms=(self.oscaling, self.world_sensor)),
            atransf=Chain(transforms=(self.forcing, self.pdescaling, self.world_sensor)),
        )

    @property
    def world_replay_to_agent(self) -> SampleTransform:
        # Imagined obs are stored already in world space; actions in agent
        # space (mbrl.py:188 + the world stack's store positions).
        return SampleTransform(otransf=self.agent_sensor, atransf=self.ascaling.inv)
