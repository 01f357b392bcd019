"""Task environments of the port.  ``make("AlignFr3Env-v1", ...)`` builds
a registered env; the task modules register themselves on import."""

from gsworld_tpu_torch.envs.registry import (  # noqa: F401
    make,
    register_env,
    registered_envs,
)


def _register_all():
    # import task modules for their registration side effects
    from gsworld_tpu_torch.envs.tasks import (  # noqa: F401
        real_fr3,
        real_xarm,
    )
    from gsworld_tpu_torch.envs.tasks.tabletop.franka import (  # noqa: F401
        align,
        pnp_box,
        pour_mustard,
        stack,
    )
    from gsworld_tpu_torch.envs.tasks.tabletop.xarm6 import (  # noqa: F401
        align as xarm_align,
        rotate_banana,
        spoon_on_board,
    )


_register_all()
