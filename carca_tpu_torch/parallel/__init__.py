"""More than one device, on ``torch.distributed`` (counterpart of
``carca_tpu/parallel``): the ``(data, model)`` rank grid
(``parallel/mesh.py``), the row-sharded table lookup
(``parallel/embedding.py``), the train and eval steps over the grid
(``parallel/step.py``), on-device negative sampling
(``parallel/sampling.py``) and full-catalog retrieval, on one device or
over an index row-sharded on the model axis (``parallel/retrieval.py``).

The step factories load on first use: ``parallel/step.py`` builds on
``train/loop.py``, which itself imports ``parallel/retrieval.py``.
"""

from carca_tpu_torch.parallel.embedding import make_sharded_lookup  # noqa: F401
from carca_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    shard_batch,
)
from carca_tpu_torch.parallel.retrieval import (  # noqa: F401
    embed_catalog,
    full_catalog_topk,
    retrieval_hr_ndcg,
    topk_given_queries,
    topk_given_queries_sharded,
)
from carca_tpu_torch.parallel.sampling import device_sample_negatives  # noqa: F401

_STEPS = ("make_sharded_train_step", "make_sharded_eval_step",
          "make_sharded_device_train_step", "make_sharded_device_eval_step")


def __getattr__(name):
    if name in _STEPS:
        from carca_tpu_torch.parallel import step

        return getattr(step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
