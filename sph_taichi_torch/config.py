"""Scene-file configuration loader.

Byte-compatible with the reference scene JSON schema (see
the reference's config_builder.py:4-37 and data/scenes/*.json): a
``Configuration`` dict plus optional ``FluidBlocks`` / ``RigidBlocks`` /
``RigidBodies`` lists.  Missing ``Configuration`` keys return ``None``
silently unless ``enforce_exist`` — same contract as the reference's
``SimConfig.get_cfg`` (config_builder.py:11-19).

Framework-specific knobs (precision, neighbor capacities, sharding) live in
an *optional* extra top-level section ``"TPU"`` so that every reference
scene file loads unchanged.
"""

import json


class SimConfig:
    def __init__(self, scene_file_path=None, config_dict=None):
        if config_dict is not None:
            self.config = config_dict
        else:
            with open(scene_file_path, "r") as f:
                self.config = json.load(f)

    def get_cfg(self, name, enforce_exist=False):
        if name not in self.config["Configuration"]:
            if enforce_exist:
                raise KeyError(
                    f"Configuration key '{name}' required but missing")
            return None
        return self.config["Configuration"][name]

    def get_fluid_blocks(self):
        return self.config.get("FluidBlocks", [])

    def get_rigid_blocks(self):
        return self.config.get("RigidBlocks", [])

    def get_rigid_bodies(self):
        return self.config.get("RigidBodies", [])

    def get_tpu_cfg(self, name, default=None):
        """Framework-extension section; absent in all reference scenes."""
        return self.config.get("TPU", {}).get(name, default)
