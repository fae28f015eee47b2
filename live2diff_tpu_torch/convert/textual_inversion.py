"""Textual inversion: learned token embeddings added to the tokenizer and
the CLIP token-embedding table.

Port of ``live2diff_tpu/convert/textual_inversion.py``. Each file carries
one or more embedding vectors: ``{"emb_params": [n, 768]}``,
``{"string_to_param": {"*": [n, 768]}}`` or a flat ``{token: [768]}``. The
vectors are appended to the table, and each new token's id is the row it
lands in.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def extract_ti_embeddings(sd: Dict, token: str) -> List[Tuple[str, torch.Tensor]]:
    """-> [(token name, vector)]; a multi-vector embedding gets numbered
    tokens (``token_0``, ``token_1``, ...)."""
    if "emb_params" in sd:
        vecs = torch.as_tensor(sd["emb_params"])
    elif "string_to_param" in sd:
        vecs = torch.as_tensor(next(iter(sd["string_to_param"].values())))
    else:
        flat = {k: torch.as_tensor(v) for k, v in sd.items()
                if torch.as_tensor(v).dim() in (1, 2)}
        if len(flat) != 1:
            return [(k, torch.atleast_2d(v)[0]) for k, v in flat.items()]
        vecs = next(iter(flat.values()))
    vecs = torch.atleast_2d(vecs)
    if len(vecs) == 1:
        return [(token, vecs[0])]
    return [(f"{token}_{i}", v) for i, v in enumerate(vecs)]


def apply_textual_inversion(tokenizer, table: torch.Tensor, sd: Dict, token: str
                            ) -> Tuple[object, torch.Tensor]:
    """-> (tokenizer, table) with the file's tokens registered and their
    vectors appended to ``table`` ``[V, D]`` in its dtype; a token the
    tokenizer already knows is left as it is."""
    new_rows = []
    for name, vec in extract_ti_embeddings(sd, token):
        if name.lower() in tokenizer.encoder:  # tokens are stored lowercased
            continue
        tokenizer.add_token(name.lower(), table.shape[0] + len(new_rows))
        new_rows.append(vec.to(table.dtype))
    if new_rows:
        table = torch.cat([table, torch.stack(new_rows).to(table.device)], dim=0)
    return tokenizer, table
