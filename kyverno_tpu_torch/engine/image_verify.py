"""verifyImages engine (reference: pkg/engine/imageVerify.go,
imageVerifyValidate.go).

This path stays host-side by design: it is network-bound (registry +
transparency log), not compute-bound — there is no TPU work here
(SURVEY.md §7 step 7). The registry client is the plugin boundary; the
hermetic mock drives tests/CLI.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional, Tuple

from ..api.policy import Policy, Rule
from ..cosign import Options, Response, fetch_attestations, verify_signature
from ..registry.client import RegistryError
from ..utils.image import ImageInfo, image_matches
from ..utils.image_extract import extract_images_from_resource
from .api import (
    EngineResponse, PolicyContext, RuleResponse, RuleStatus, RuleType,
)
from .operators import evaluate_conditions
from .variables import substitute_all, substitute_all_in_preconditions

IMAGE_VERIFY_ANNOTATION = 'kyverno.io/verify-images'


class ImageVerificationMetadata:
    """reference: pkg/engine/imageVerifyMetadata.go"""

    def __init__(self, data: Optional[Dict[str, bool]] = None):
        self.data: Dict[str, bool] = data or {}

    def add(self, image: str, verified: bool) -> None:
        self.data[image] = verified

    def is_verified(self, image: str) -> bool:
        return self.data.get(image, False)

    def is_empty(self) -> bool:
        return not self.data

    @classmethod
    def parse(cls, annotation: str) -> 'ImageVerificationMetadata':
        return cls(json.loads(annotation))

    def annotation_patches(self, resource: dict) -> List[dict]:
        """JSONPatch ops installing the verification annotation
        (reference: imageVerifyMetadata.go Patches)."""
        if self.is_empty():
            return []
        value = json.dumps(self.data, separators=(',', ':'), sort_keys=True)
        patches = []
        meta = resource.get('metadata') or {}
        if 'annotations' not in meta:
            patches.append({'op': 'add', 'path': '/metadata/annotations',
                            'value': {}})
        key = IMAGE_VERIFY_ANNOTATION.replace('~', '~0').replace('/', '~1')
        patches.append({'op': 'add',
                        'path': f'/metadata/annotations/{key}',
                        'value': value})
        return patches


def _convert(iv: dict) -> dict:
    """Backward-compat normalization (reference:
    api/kyverno/v1/image_verification_types.go:371 Convert)."""
    if not iv.get('image') and not iv.get('key') and not iv.get('issuer'):
        return iv
    out = copy.deepcopy(iv)
    for field in ('image', 'issuer', 'subject', 'roots'):
        out.pop(field, None)
    if iv.get('image'):
        out.setdefault('imageReferences', []).append(iv['image'])
    if iv.get('annotations') or iv.get('key') or iv.get('issuer'):
        attestor: dict = {}
        if iv.get('annotations'):
            attestor['annotations'] = iv['annotations']
        if iv.get('key'):
            attestor['keys'] = {'publicKeys': iv['key']}
        elif iv.get('issuer'):
            attestor['keyless'] = {'issuer': iv['issuer'],
                                   'subject': iv.get('subject', ''),
                                   'roots': iv.get('roots', '')}
        attestor_set = {'entries': [attestor]}
        if iv.get('attestations'):
            for att in out.get('attestations') or []:
                att.setdefault('attestors', []).append(attestor_set)
        else:
            out.setdefault('attestors', []).append(attestor_set)
    return out


def _expand_static_keys(attestor_set: dict) -> dict:
    """reference: imageVerify.go:530 expandStaticKeys"""
    entries = []
    for e in attestor_set.get('entries') or []:
        keys = (e.get('keys') or {}).get('publicKeys', '')
        if keys:
            split = [k for k in
                     (s for s in _split_pem(keys)) if k.strip()]
            if len(split) > 1:
                entries.extend({'keys': {'publicKeys': k}} for k in split)
                continue
        entries.append(e)
    return {'count': attestor_set.get('count'), 'entries': entries}


def _split_pem(pem: str) -> List[str]:
    """reference: imageVerify.go:551 splitPEM"""
    marker = '-----END PUBLIC KEY-----'
    parts = pem.split(marker)
    return [p + marker for p in parts[:-1]] if len(parts) > 1 else [pem]


def _required_count(attestor_set: dict) -> int:
    """reference: imageVerify.go:574 getRequiredCount"""
    count = attestor_set.get('count')
    if not count:
        return len(attestor_set.get('entries') or [])
    return int(count)


def is_image_verified(resource: dict, image: str) -> bool:
    """reference: imageVerifyValidate.go:104 isImageVerified — raises
    ValueError when the annotation is missing/invalid."""
    if not resource:
        raise ValueError('nil resource')
    annotations = (resource.get('metadata') or {}).get('annotations') or {}
    if not annotations:
        return False
    data = annotations.get(IMAGE_VERIFY_ANNOTATION)
    if data is None:
        raise ValueError('image is not verified')
    try:
        ivm = ImageVerificationMetadata.parse(data)
    except Exception as exc:
        raise ValueError(f'failed to parse image metadata: {exc}') from exc
    return ivm.is_verified(image)


class ImageVerifier:
    """reference: pkg/engine/imageVerify.go:203 imageVerifier"""

    def __init__(self, rclient, pctx: PolicyContext, rule: Rule,
                 resp: EngineResponse, ivm: ImageVerificationMetadata):
        self.rclient = rclient
        self.pctx = pctx
        self.rule = rule
        self.resp = resp
        self.ivm = ivm

    def verify(self, image_verify: dict,
               matched_images: List[ImageInfo]) -> None:
        """reference: imageVerify.go:214 verify"""
        image_verify = _convert(image_verify)
        for info in matched_images:
            image = str(info)
            # gate every entry (incl. attestation-only) on its own
            # imageReferences: the per-rule match list is the union over
            # entries, so sibling entries' images must not leak in
            if not image_matches(image, image_verify.get('imageReferences')):
                continue
            if self._annotation_changed():
                msg = f'{IMAGE_VERIFY_ANNOTATION} annotation cannot be changed'
                self._append(RuleResponse(self.rule.name,
                                          RuleType.IMAGE_VERIFY, msg,
                                          RuleStatus.FAIL))
                continue
            try:
                if is_image_verified(self.pctx.new_resource, image):
                    continue
            except ValueError:
                pass
            # verification works on a copy: digest discovery during
            # attestor/attestation checks must not suppress the mutate-digest
            # patch (the reference passes ImageInfo by value)
            work = ImageInfo(info.registry, info.name, info.path, info.tag,
                             info.digest, info.pointer)
            rule_resp, digest = self._verify_image(image_verify, work)
            if image_verify.get('mutateDigest', True):
                rule_resp, digest = self._mutate_digest(rule_resp, digest, info)
            if rule_resp is not None:
                if image_verify.get('attestors') or \
                        image_verify.get('attestations'):
                    self.ivm.add(image, rule_resp.status == RuleStatus.PASS)
                self._append(rule_resp)

    def _append(self, rule_resp: RuleResponse) -> None:
        self.resp.policy_response.rules.append(rule_resp)
        if rule_resp.status in (RuleStatus.PASS, RuleStatus.FAIL):
            self.resp.policy_response.rules_applied_count += 1
        elif rule_resp.status == RuleStatus.ERROR:
            self.resp.policy_response.rules_error_count += 1

    def _annotation_changed(self) -> bool:
        """reference: imageVerify.go:295 hasImageVerifiedAnnotationChanged"""
        new, old = self.pctx.new_resource, self.pctx.old_resource
        if not new or not old:
            return False
        key = IMAGE_VERIFY_ANNOTATION
        get = (lambda r: ((r.get('metadata') or {}).get('annotations') or {})
               .get(key, ''))
        return get(new) != get(old)

    def _mutate_digest(self, rule_resp: Optional[RuleResponse], digest: str,
                       info: ImageInfo
                       ) -> Tuple[Optional[RuleResponse], str]:
        """reference: imageVerify.go:272 handleMutateDigest"""
        if info.digest:
            return rule_resp, digest
        if not digest:
            try:
                digest = self.rclient.fetch_image_descriptor(str(info)).digest
            except RegistryError as err:
                return (RuleResponse(
                    self.rule.name, RuleType.IMAGE_VERIFY,
                    f'failed to update digest: {err}', RuleStatus.ERROR),
                    '')
        if not digest:
            return rule_resp, digest
        patch = {'op': 'replace', 'path': info.pointer,
                 'value': f'{info}@{digest}'}
        if rule_resp is None:
            rule_resp = RuleResponse(self.rule.name, RuleType.IMAGE_VERIFY,
                                     'mutated image digest', RuleStatus.PASS)
        rule_resp.patches.append(patch)
        info.digest = digest
        return rule_resp, digest

    def _verify_image(self, image_verify: dict, info: ImageInfo
                      ) -> Tuple[Optional[RuleResponse], str]:
        """reference: imageVerify.go:324 verifyImage"""
        if not image_verify.get('attestors') and \
                not image_verify.get('attestations'):
            return None, ''
        image = str(info)
        self.pctx.json_context.add_json(
            {'image': info.to_dict() | {'reference': image}})
        if image_verify.get('attestors'):
            if not image_matches(image, image_verify.get('imageReferences')):
                return None, ''
            rule_resp, cosign_resp = self._verify_attestors(
                image_verify.get('attestors'), image_verify, info)
            if rule_resp.status != RuleStatus.PASS:
                return rule_resp, ''
            if not image_verify.get('attestations'):
                return rule_resp, cosign_resp.digest
            if not info.digest:
                info.digest = cosign_resp.digest
        return self._verify_attestations(image_verify, info)

    def _verify_attestors(self, attestors: List[dict], image_verify: dict,
                          info: ImageInfo
                          ) -> Tuple[RuleResponse, Optional[Response]]:
        """reference: imageVerify.go:374 verifyAttestors"""
        image = str(info)
        cosign_resp = None
        for attestor_set in attestors or []:
            try:
                cosign_resp = self._verify_attestor_set(
                    attestor_set, image_verify, info)
            except RegistryError as err:
                msg = f'failed to verify image {image}: {err}'
                return (RuleResponse(self.rule.name, RuleType.IMAGE_VERIFY,
                                     msg, RuleStatus.FAIL), None)
        if cosign_resp is None:
            return (RuleResponse(self.rule.name, RuleType.IMAGE_VERIFY,
                                 'invalid response: nil', RuleStatus.ERROR),
                    None)
        return (RuleResponse(self.rule.name, RuleType.IMAGE_VERIFY,
                             f'verified image signatures for {image}',
                             RuleStatus.PASS), cosign_resp)

    def _verify_attestor_set(self, attestor_set: dict, image_verify: dict,
                             info: ImageInfo) -> Response:
        """reference: imageVerify.go:479 verifyAttestorSet"""
        attestor_set = _expand_static_keys(attestor_set)
        required = _required_count(attestor_set)
        verified = 0
        errors: List[str] = []
        resp = None
        for entry in attestor_set.get('entries') or []:
            try:
                if entry.get('attestor'):
                    resp = self._verify_attestor_set(
                        entry['attestor'], image_verify, info)
                else:
                    opts = self._build_options(entry, image_verify,
                                               str(info), None)
                    resp = verify_signature(self.rclient, opts)
                verified += 1
                if verified >= required:
                    return resp
            except RegistryError as err:
                errors.append(str(err))
        raise RegistryError('; '.join(errors) or
                            f'verification failed for {info}')

    def _verify_attestations(self, image_verify: dict, info: ImageInfo
                             ) -> Tuple[RuleResponse, str]:
        """reference: imageVerify.go:414 verifyAttestations"""
        image = str(info)
        for attestation in image_verify.get('attestations') or []:
            predicate_type = attestation.get('predicateType', '')
            if not predicate_type:
                return (RuleResponse(self.rule.name, RuleType.IMAGE_VERIFY,
                                     'missing predicateType',
                                     RuleStatus.FAIL), '')
            attestors = attestation.get('attestors') or [{'entries': [{}]}]
            for attestor_set in attestors:
                required = _required_count(attestor_set)
                verified = 0
                for entry in attestor_set.get('entries') or []:
                    opts = self._build_options(entry, image_verify, image,
                                               attestation)
                    try:
                        cosign_resp = fetch_attestations(self.rclient, opts)
                    except RegistryError as err:
                        return (RuleResponse(
                            self.rule.name, RuleType.IMAGE_VERIFY,
                            f'failed to verify image {image}: {err}',
                            RuleStatus.FAIL), '')
                    if not info.digest:
                        info.digest = cosign_resp.digest
                        image = str(info)
                    err_msg = self._check_attestation_statements(
                        cosign_resp.statements, attestation, info)
                    if err_msg:
                        return (RuleResponse(
                            self.rule.name, RuleType.IMAGE_VERIFY, err_msg,
                            RuleStatus.FAIL), '')
                    verified += 1
                    if verified >= required:
                        break
                if verified < required:
                    msg = (f'image attestations verification failed, '
                           f'verifiedCount: {verified}, '
                           f'requiredCount: {required}')
                    return (RuleResponse(self.rule.name,
                                         RuleType.IMAGE_VERIFY, msg,
                                         RuleStatus.FAIL), '')
        return (RuleResponse(self.rule.name, RuleType.IMAGE_VERIFY,
                             f'verified image attestations for {image}',
                             RuleStatus.PASS), info.digest)

    def _check_attestation_statements(self, statements: List[dict],
                                      attestation: dict,
                                      info: ImageInfo) -> str:
        """reference: imageVerify.go:651 verifyAttestation"""
        predicate_type = attestation.get('predicateType', '')
        matching = [s for s in statements
                    if s.get('predicateType') == predicate_type]
        if not matching:
            return (f'attestions not found for predicate type '
                    f'{predicate_type}')
        for statement in matching:
            ok, err = self._check_attestation_conditions(attestation,
                                                         statement)
            if err:
                return f'failed to check attestations: {err}'
            if not ok:
                return (f'attestation checks failed for {info} and '
                        f'predicate {predicate_type}')
        return ''

    def _check_attestation_conditions(self, attestation: dict,
                                      statement: dict
                                      ) -> Tuple[bool, str]:
        """reference: imageVerify.go:698 checkAttestations + :709
        evaluateConditions"""
        conditions = attestation.get('conditions') or []
        if not conditions:
            return True, ''
        predicate = statement.get('predicate')
        if not isinstance(predicate, dict):
            return False, f'failed to extract predicate from statement'
        ctx = self.pctx.json_context
        ctx.checkpoint()
        try:
            ctx.add_json(predicate)
            try:
                substituted = substitute_all(ctx, conditions)
            except Exception as exc:  # noqa: BLE001
                return False, f'failed to substitute variables: {exc}'
            return (all(evaluate_conditions(ctx, c) for c in substituted),
                    '')
        finally:
            ctx.restore()

    def _build_options(self, attestor: dict, image_verify: dict, image: str,
                       attestation: Optional[dict]) -> Options:
        """reference: imageVerify.go:582 buildOptionsAndPath"""
        keys = attestor.get('keys') or {}
        keyless = attestor.get('keyless') or {}
        certs = attestor.get('certificates') or {}
        # every attestor flavor may carry a rekor block
        # (image_verification_types.go:149,173,181); nil → not checked
        rekor = keys.get('rekor') or certs.get('rekor') or \
            keyless.get('rekor') or {}
        return Options(
            image_ref=image,
            key=(keys.get('publicKeys') or '').strip(),
            cert=certs.get('cert', ''),
            cert_chain=certs.get('certChain', ''),
            roots=keyless.get('roots', ''),
            subject=keyless.get('subject', ''),
            issuer=keyless.get('issuer', ''),
            annotations=attestor.get('annotations') or {},
            repository=(attestor.get('repository')
                        or image_verify.get('repository', '')),
            rekor_url=rekor.get('url', ''),
            rekor_pubkey=rekor.get('pubkey', ''),
            ignore_tlog=bool(rekor.get('ignoreTlog', False)),
            predicate_type=(attestation or {}).get('predicateType', ''),
            fetch_attestations=attestation is not None,
        )


def get_matching_images(pctx: PolicyContext, rule: Rule
                        ) -> Tuple[List[ImageInfo], str]:
    """reference: imageVerify.go:50 extractMatchingImages"""
    infos = extract_images_from_resource(
        pctx.new_resource, rule.raw.get('imageExtractors'))
    all_infos = [info for group in infos.values() for info in group.values()]
    refs = []
    matched = []
    for iv in rule.verify_images:
        iv = _convert(iv)
        patterns = iv.get('imageReferences') or []
        refs.extend(patterns)
        for info in all_infos:
            if image_matches(str(info), patterns):
                matched.append(info)
    return matched, ','.join(refs)


def verify_and_patch_images(engine, pctx: PolicyContext, rclient
                            ) -> Tuple[EngineResponse,
                                       ImageVerificationMetadata]:
    """reference: pkg/engine/imageVerify.go:69 VerifyAndPatchImages"""
    import time
    start = time.time()
    resp = EngineResponse(pctx.policy)
    ivm = ImageVerificationMetadata()
    policy = pctx.policy
    apply_rules = policy.apply_rules
    ctx = pctx.json_context
    _add_resource_images(pctx)
    ctx.checkpoint()
    try:
        for raw_rule in engine._compute_rules(policy):
            rule = Rule(raw_rule)
            if not rule.verify_images:
                continue
            if not engine._matches(rule, pctx):
                continue
            exception_resp = engine._check_exceptions(pctx, rule)
            if exception_resp is not None:
                resp.policy_response.rules.append(exception_resp)
                continue
            matched, refs = _matching_or_error(pctx, rule, resp)
            if matched is None:
                continue
            if not matched:
                resp.policy_response.rules.append(RuleResponse(
                    rule.name, RuleType.IMAGE_VERIFY,
                    f"skip run verification as image in resource not "
                    f"found in imageRefs '{refs}'", RuleStatus.SKIP))
                continue
            ctx.reset()
            try:
                engine.context_loader.load(rule.context, ctx,
                                           policy_name=pctx.policy.name,
                                           rule_name=rule.name)
            except Exception as exc:  # noqa: BLE001
                resp.policy_response.rules.append(RuleResponse(
                    rule.name, RuleType.IMAGE_VERIFY,
                    f'failed to load context: {exc}', RuleStatus.ERROR))
                continue
            try:
                substituted = _substitute_rule_variables(ctx, raw_rule)
            except Exception as exc:  # noqa: BLE001
                resp.policy_response.rules.append(RuleResponse(
                    rule.name, RuleType.IMAGE_VERIFY,
                    f'failed to substitute variables: {exc}',
                    RuleStatus.ERROR))
                continue
            if rclient is None:
                resp.policy_response.rules.append(RuleResponse(
                    rule.name, RuleType.IMAGE_VERIFY,
                    'image verification requires a registry client',
                    RuleStatus.ERROR))
                continue
            verifier = ImageVerifier(rclient, pctx, substituted, resp, ivm)
            for image_verify in substituted.verify_images:
                verifier.verify(image_verify, matched)
            if apply_rules == 'One' and \
                    resp.policy_response.rules_applied_count > 0:
                break
    finally:
        ctx.restore()
    engine._build_response(pctx, resp, start)
    return resp, ivm


def _substitute_rule_variables(ctx, raw_rule: dict) -> Rule:
    """Substitute variables everywhere except attestations, whose
    conditions resolve against each statement's predicate at check time
    (reference: imageVerify.go:182 substituteVariables)."""
    rule_copy = copy.deepcopy(raw_rule)
    saved = []
    for iv in rule_copy.get('verifyImages') or []:
        saved.append(copy.deepcopy(iv.get('attestations')))
        iv.pop('attestations', None)
    rule_copy = substitute_all(ctx, rule_copy)
    for iv, attestations in zip(rule_copy.get('verifyImages') or [], saved):
        if attestations is not None:
            iv['attestations'] = attestations
    return Rule(rule_copy)


def _matching_or_error(pctx, rule, resp):
    try:
        return get_matching_images(pctx, rule)
    except Exception as exc:  # noqa: BLE001
        resp.policy_response.rules.append(RuleResponse(
            rule.name, RuleType.IMAGE_VERIFY,
            f'failed to extract images: {exc}', RuleStatus.ERROR))
        return None, ''


def _add_resource_images(pctx: PolicyContext) -> None:
    try:
        infos = extract_images_from_resource(pctx.new_resource)
    except Exception:  # noqa: BLE001 — kinds without extractors
        return
    if infos:
        pctx.json_context.add_image_infos(
            {name: {k: i.to_dict() for k, i in group.items()}
             for name, group in infos.items()})


def process_image_validation_rule(engine, pctx: PolicyContext,
                                  rule: Rule) -> Optional[RuleResponse]:
    """Audit/background validate-mode check of verifyImages rules against
    the kyverno.io/verify-images annotation
    (reference: pkg/engine/imageVerifyValidate.go:18
    processImageValidationRule)."""
    try:
        matched, _ = get_matching_images(pctx, rule)
    except Exception as exc:  # noqa: BLE001
        return RuleResponse(rule.name, RuleType.VALIDATION, str(exc),
                            RuleStatus.ERROR)
    if not matched:
        return RuleResponse(rule.name, RuleType.VALIDATION, 'image verified',
                            RuleStatus.SKIP)
    ctx = pctx.json_context
    try:
        engine.context_loader.load(rule.context, ctx,
                                   policy_name=pctx.policy.name,
                                   rule_name=rule.name)
    except Exception as exc:  # noqa: BLE001
        return RuleResponse(rule.name, RuleType.VALIDATION,
                            f'failed to load context: {exc}',
                            RuleStatus.ERROR)
    try:
        conditions = substitute_all_in_preconditions(ctx, rule.preconditions)
    except Exception as exc:  # noqa: BLE001
        return RuleResponse(rule.name, RuleType.VALIDATION,
                            f'failed to evaluate preconditions: {exc}',
                            RuleStatus.ERROR)
    if conditions is not None and not evaluate_conditions(ctx, conditions):
        return RuleResponse(rule.name, RuleType.VALIDATION,
                            'preconditions not met', RuleStatus.SKIP)
    for iv in rule.verify_images:
        image_verify = _convert(iv)
        for info in matched:
            image = str(info)
            if not image_matches(image, image_verify.get('imageReferences')):
                continue
            if image_verify.get('verifyDigest', True) and not info.digest:
                return RuleResponse(rule.name, RuleType.IMAGE_VERIFY,
                                    f'missing digest for {image}',
                                    RuleStatus.FAIL)
            if image_verify.get('required', True) and pctx.new_resource:
                try:
                    verified = is_image_verified(pctx.new_resource, image)
                except ValueError as err:
                    return RuleResponse(rule.name, RuleType.IMAGE_VERIFY,
                                        str(err), RuleStatus.FAIL)
                if not verified:
                    return RuleResponse(rule.name, RuleType.IMAGE_VERIFY,
                                        f'unverified image {image}',
                                        RuleStatus.FAIL)
    return RuleResponse(rule.name, RuleType.VALIDATION, 'image verified',
                        RuleStatus.PASS)
