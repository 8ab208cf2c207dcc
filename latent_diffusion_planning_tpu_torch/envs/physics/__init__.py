"""Rigid-body physics core, batched over envs.

Counterpart of ``latent_diffusion_planning_tpu/envs/physics``.
"""

from .engine import (GEOM_BOX, GEOM_SPHERE, Contact, Geom, PhysicsParams,
                     RigidBody, World, build_geoms, contact_forces,
                     free_body_step, generate_contacts, make_box_geom,
                     make_sphere_geom, multi_step, pair_in_contact)

__all__ = ["GEOM_BOX", "GEOM_SPHERE", "Contact", "Geom", "PhysicsParams",
           "RigidBody", "World", "build_geoms", "contact_forces",
           "free_body_step", "generate_contacts", "make_box_geom",
           "make_sphere_geom", "multi_step", "pair_in_contact"]
