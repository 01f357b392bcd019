"""Task environments of the port.  ``make("AlignFr3Env-v1", ...)`` builds
a registered env; the task modules register themselves on import."""

from gsworld_tpu_torch.envs.registry import (  # noqa: F401
    make,
    register_env,
    registered_envs,
)


def _register_all():
    # import task modules for their registration side effects
    from gsworld_tpu_torch.envs.tasks import real_fr3  # noqa: F401
    from gsworld_tpu_torch.envs.tasks.tabletop.franka import (  # noqa: F401
        align,
    )


_register_all()
