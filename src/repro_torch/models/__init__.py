"""The model zoo in PyTorch (counterpart of ``repro/models``).

``repro_torch.models.model.build_model(config)`` returns a :class:`Model`
bundle with ``init / loss_fn / forward / init_cache / decode_step``.
"""

from repro_torch.models.model import Model, build_model  # noqa: F401
