"""The converter of the rigid and texture variants (nearest-vertex
skinning; the distilled skinning voxel; the wide MLP texture) against the
JAX package's: forward before and past every gate, the gradients of every
parameter, of the subject constants and of the arena, the clip norm and two
optimizer steps (tests/torch_variant_case.py)."""
import pytest

from torch_variant_case import VARIANTS, VariantCase
from torch_variant_case import (test_clip_norm_and_optimizer,  # noqa: F401
                                test_converter_forward,
                                test_converter_gradients,
                                test_subject_constant_gradients)


@pytest.fixture(scope='module', params=['v_smpl_nn', 'v_distill',
                                        'v_wide_tex'])
def case(request):
    return VariantCase(VARIANTS[request.param])
