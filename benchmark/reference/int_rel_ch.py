"""Plain reference of int_rel_ch, the joint interaction, relationship and
character-grounding model (MidFusionMultiClipMaxTracks with the 18-clip
relationship context and the gate), trained weakly (the positive
hypothesis is the best-scoring one; MarginTrackRelsLoss). The published
code: reference resume/int_rel_ch.py, mlp/model.py. The arithmetic is
reference/plain.py's; this module holds it to the configuration's model."""

from reference.plain import (adam_step, bf16_quant, counters, embed_tables,
                             forward_eval, forward_rows, fp8_quant,
                             grounding_loss, near_ties, no_tf32,
                             param_shapes, selection_scores, train_steps)

__all__ = ["param_shapes", "fp8_quant", "bf16_quant", "no_tf32",
           "forward_rows", "embed_tables", "forward_eval",
           "selection_scores", "grounding_loss", "counters", "adam_step",
           "near_ties", "train_steps", "MODEL", "TIE_WINDOW"]

# where the weak loss chooses a sample's positive hypothesis by less than
# this (in its selection score, a sum of sigmoids), the choice is not
# determined at the configuration's bfloat16 compute: the first gradient
# is compared with the nearest of the choices within it. Over twice the
# widest gap between the program's score and this reference's, read at
# the cell's size on 14 seeds (4.3e-4; bfloat16 products: 4.1e-4)
TIE_WINDOW = 1e-3
# what this reference computes: the configuration file must say the same
MODEL = {"ctx": True, "gates": True, "tr_maximize": True, "tr_correct": False,
         "tr_cat_distr": False, "tr_max_neg": False}
