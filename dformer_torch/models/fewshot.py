"""Few-shot segmentation helpers and the contrastive prototype loss
(counterpart of `dformer_tpu/models/fewshot.py`).

`FewShotSegmentation` is the standalone prototype-matching forward around
a trained EncoderDecoder (the episodic fine-tune path is
`EncoderDecoder.meta_forward`); `contrastive_loss` is the InfoNCE-style
prototype loss (temperature 0.1) of the class-episode recipe.
"""

import torch
import torch.nn.functional as F

from dformer_torch.ops.resize import resize_bilinear


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def compute_prototypes(features, masks, num_classes: int = 2):
    """Class prototypes from support features: features [N,h,w,C], masks
    [N,h,w] integer -> [num_classes, N, C], the masked mean of each class
    in each image."""
    protos = []
    for c in range(num_classes):
        m = (masks == c).to(features.dtype)[..., None]
        protos.append((features * m).sum((1, 2)) / (m.sum((1, 2)) + 1e-8))
    return torch.stack(protos)


def match_prototypes(q_features, prototypes):
    """Each query pixel's most similar prototype (cosine): q_features
    [B,h,w,C], prototypes [K,B,C] -> [B,h,w] class ids."""
    sim = torch.einsum("bhwc,kbc->bkhw", _unit(q_features), _unit(prototypes))
    return torch.argmax(sim, dim=1)


class FewShotSegmentation:
    """Prototype-matching episode forward over a model in eval mode."""

    def __init__(self, model):
        self.model = model

    @torch.inference_mode()
    def __call__(self, s_imgs, s_depths, s_masks, q_imgs, q_depths):
        self.model.eval()
        s_feats = self.model.encode(s_imgs, s_depths)[-1]
        q_feats = self.model.encode(q_imgs, q_depths)[-1]
        m = resize_bilinear(s_masks[..., None].float(),
                            s_feats.shape[1:3])[..., 0]
        protos = compute_prototypes(s_feats, torch.round(m).long())
        return match_prototypes(q_feats, protos)


def contrastive_loss(q_features, prototypes, q_masks,
                     temperature: float = 0.1):
    """Prototype InfoNCE: query pixels should be closer to their class
    prototype than to the others. q_features [B,h,w,C]; prototypes
    [K,B,C]; q_masks [B,h,w] integer (clipped to [0, K))."""
    sim = torch.einsum("bhwc,kbc->bkhw", _unit(q_features), _unit(prototypes))
    K = prototypes.shape[0]
    onehot = F.one_hot(q_masks.long().clamp(0, K - 1), K)
    onehot = onehot.permute(0, 3, 1, 2).to(sim.dtype)
    pos = (sim * onehot).sum(1)
    neg = (sim * (1 - onehot)).sum(1) / max(K - 1, 1)
    logits = torch.stack([pos, neg], dim=-1) / temperature
    return -torch.log_softmax(logits, dim=-1)[..., 0].mean()
