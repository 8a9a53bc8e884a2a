from mayamatchmovesolver_torch.scene.attrblock import (  # noqa: F401
    ATTR_NONE,
    AttrBlock,
    AttrBlockBuilder,
    anim_code,
    gather_attr_values,
    static_code,
)
from mayamatchmovesolver_torch.scene.flatscene import (  # noqa: F401
    FlatScene,
    SceneEval,
    evaluate,
)
from mayamatchmovesolver_torch.scene.scenegraph import (  # noqa: F401
    Attribute,
    BundleNode,
    CameraNode,
    MarkerNode,
    SceneGraph,
    TransformNode,
)
