"""Install-time cluster objects the chart ships (reference:
charts/kyverno/templates/rbac/aggregated-roles — the aggregated
ClusterRoles that surface kyverno CRs to the built-in admin/view roles,
asserted by test/conformance/kuttl/rbac/aggregate-to-admin).

The daemons assume these exist the way the reference assumes its Helm
install ran; ``seed_install_manifests`` creates them idempotently.
"""

from __future__ import annotations

_CRUD_VERBS = ['create', 'delete', 'get', 'list', 'patch', 'update',
               'watch']

_AGGREGATED_ADMIN_ROLES = [
    ('kyverno:admin:policies', 'kyverno.io',
     ['cleanuppolicies', 'clustercleanuppolicies', 'policies',
      'clusterpolicies']),
    ('kyverno:admin:policyreports', 'wgpolicyk8s.io',
     ['policyreports', 'clusterpolicyreports']),
    ('kyverno:admin:reports', 'kyverno.io',
     ['admissionreports', 'clusteradmissionreports',
      'backgroundscanreports', 'clusterbackgroundscanreports']),
    ('kyverno:admin:updaterequests', 'kyverno.io',
     ['updaterequests']),
]


def install_cluster_roles() -> list:
    """The aggregated admin ClusterRoles as unstructured docs."""
    docs = []
    for name, group, resources in _AGGREGATED_ADMIN_ROLES:
        docs.append({
            'apiVersion': 'rbac.authorization.k8s.io/v1',
            'kind': 'ClusterRole',
            'metadata': {
                'name': name,
                'labels': {
                    'rbac.authorization.k8s.io/aggregate-to-admin': 'true',
                },
            },
            'rules': [{
                'apiGroups': [group],
                'resources': list(resources),
                'verbs': list(_CRUD_VERBS),
            }],
        })
    return docs


def seed_install_manifests(client) -> None:
    """Create the install-time objects in ``client`` (idempotent)."""
    from ..dclient.client import ApiError
    for doc in install_cluster_roles():
        try:
            client.create_resource(doc['apiVersion'], doc['kind'], '', doc)
        except ApiError:
            pass
