"""Plans / configuration management (copy of
``nnuzoo_tpu/plans/plans_handler.py``, trimmed to what planning, preprocessing,
prediction and training read).

JSON schema is kept compatible with the reference
(`nnunetv2/utilities/plans_handling/plans_handler.py:31-346`): a plans file has
dataset-level keys (``dataset_name``, ``plans_name``, ``transpose_forward/backward``,
``image_reader_writer``, ``foreground_intensity_properties_per_channel``) plus a
``configurations`` dict whose entries support ``inherits_from`` inheritance (resolved
recursively with cycle detection) and cascade wiring (``previous_stage``/``next_stage``).

Resampling-function and preprocessor names in plans resolve through explicit
registries. The architecture fields name the JAX package's dynamic UNet; the
port reads them as data and imports nothing by those names.
"""

from copy import deepcopy
from functools import partial
from typing import List, Optional, Tuple, Union

from ..utilities.io import load_json
from .label_handling import LabelManager


class ConfigurationManager:
    """Typed accessors over one resolved configuration dict."""

    def __init__(self, configuration_dict: dict):
        self.configuration = configuration_dict

    def __repr__(self):
        return repr(self.configuration)

    @property
    def data_identifier(self) -> str:
        return self.configuration["data_identifier"]

    @property
    def preprocessor_name(self) -> str:
        return self.configuration["preprocessor_name"]

    @property
    def preprocessor_class(self):
        from ..preprocessing.preprocessor import get_preprocessor_class_by_name
        return get_preprocessor_class_by_name(self.preprocessor_name)

    @property
    def batch_size(self) -> int:
        return self.configuration["batch_size"]

    @property
    def patch_size(self) -> List[int]:
        return self.configuration["patch_size"]

    @property
    def median_image_size_in_voxels(self) -> List[int]:
        return self.configuration["median_image_size_in_voxels"]

    @property
    def spacing(self) -> List[float]:
        return self.configuration["spacing"]

    @property
    def normalization_schemes(self) -> List[str]:
        return self.configuration["normalization_schemes"]

    @property
    def use_mask_for_norm(self) -> List[bool]:
        return self.configuration["use_mask_for_norm"]

    def _resampling_fn(self, key: str):
        from ..preprocessing.resampling import get_resampling_fn_by_name
        fn = get_resampling_fn_by_name(self.configuration[key])
        return partial(fn, **self.configuration.get(key + "_kwargs", {}))

    @property
    def resampling_fn_data(self):
        return self._resampling_fn("resampling_fn_data")

    @property
    def resampling_fn_seg(self):
        return self._resampling_fn("resampling_fn_seg")

    @property
    def resampling_fn_probabilities(self):
        return self._resampling_fn("resampling_fn_probabilities")

    @property
    def network_arch_class_name(self) -> str:
        return self.configuration["architecture"]["network_class_name"]

    @property
    def network_arch_init_kwargs(self) -> dict:
        return self.configuration["architecture"]["arch_kwargs"]

    @property
    def network_arch_init_kwargs_req_import(self):
        return self.configuration["architecture"].get("_kw_requires_import", ())

    @property
    def pool_op_kernel_sizes(self) -> Tuple[Tuple[int, ...], ...]:
        return self.configuration["architecture"]["arch_kwargs"]["strides"]

    @property
    def batch_dice(self) -> bool:
        return self.configuration["batch_dice"]

    @property
    def next_stage_names(self) -> Optional[List[str]]:
        ret = self.configuration.get("next_stage")
        if ret is not None and isinstance(ret, str):
            ret = [ret]
        return ret

    @property
    def previous_stage_name(self) -> Optional[str]:
        return self.configuration.get("previous_stage")


class PlansManager:
    def __init__(self, plans_file_or_dict: Union[str, dict]):
        self.plans = (plans_file_or_dict if isinstance(plans_file_or_dict, dict)
                      else load_json(plans_file_or_dict))
        self._config_cache = {}

    def __repr__(self):
        return repr(self.plans)

    def _resolve_inheritance(self, configuration_name: str,
                             visited: Tuple[str, ...] = ()) -> dict:
        if configuration_name not in self.plans["configurations"]:
            raise ValueError(
                f"Configuration {configuration_name!r} does not exist. Valid names: "
                f"{list(self.plans['configurations'].keys())}")
        configuration = deepcopy(self.plans["configurations"][configuration_name])
        parent = configuration.get("inherits_from")
        if parent is not None:
            if parent in visited:
                raise RuntimeError(
                    f"Circular inheritance detected while resolving "
                    f"{configuration_name!r}: visited {visited + (configuration_name,)}")
            base = self._resolve_inheritance(parent, visited + (configuration_name,))
            base.update(configuration)
            configuration = base
        return configuration

    def get_configuration(self, configuration_name: str) -> ConfigurationManager:
        if configuration_name not in self._config_cache:
            self._config_cache[configuration_name] = ConfigurationManager(
                self._resolve_inheritance(configuration_name))
        return self._config_cache[configuration_name]

    # ------------------------------------------------------------ dataset-level keys
    @property
    def dataset_name(self) -> str:
        return self.plans["dataset_name"]

    @property
    def plans_name(self) -> str:
        return self.plans["plans_name"]

    @property
    def original_median_spacing_after_transp(self) -> List[float]:
        return self.plans["original_median_spacing_after_transp"]

    @property
    def original_median_shape_after_transp(self) -> List[float]:
        return self.plans["original_median_shape_after_transp"]

    @property
    def image_reader_writer_class(self):
        from ..imageio.registry import find_reader_writer_by_name
        return find_reader_writer_by_name(self.plans["image_reader_writer"])

    @property
    def transpose_forward(self) -> List[int]:
        return self.plans["transpose_forward"]

    @property
    def transpose_backward(self) -> List[int]:
        return self.plans["transpose_backward"]

    @property
    def available_configurations(self) -> List[str]:
        return list(self.plans["configurations"].keys())

    @property
    def experiment_planner_name(self) -> str:
        return self.plans["experiment_planner_used"]

    def get_label_manager(self, dataset_json: dict, **kwargs) -> LabelManager:
        return LabelManager(
            label_dict=dataset_json["labels"],
            target_type=dataset_json.get("target_type", "segmentation"),
            regions_class_order=dataset_json.get("regions_class_order"),
            **kwargs)

    @property
    def foreground_intensity_properties_per_channel(self) -> dict:
        plans = self.plans
        if "foreground_intensity_properties_per_channel" not in plans:
            if "foreground_intensity_properties_by_modality" in plans:
                return plans["foreground_intensity_properties_by_modality"]
        return plans["foreground_intensity_properties_per_channel"]
